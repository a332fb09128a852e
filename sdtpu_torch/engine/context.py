"""Context: the pipeline orchestrator, the counterpart of
``sdtpu/engine/context.py`` for the txt2img path.

Lifecycle: load models -> load tokenizer -> prepare buffers (the cached
uncond ``""`` embedding) -> generate. A failed phase latches the context:
every later ``generate`` raises ``INVALID_CONTEXT``. A failure inside one
``generate`` or batch (a kernel wrapper, its build or launch, torch) comes
out as ``SdtpuError(RUNTIME_ERROR)`` and latches nothing.

Configurations: ``"sd15"``, ``"sd21"`` (768x768, v-prediction),
``"sd21base"`` (512x512) and ``"sdxl"`` (1024x1024, two text towers, the
pooled and micro-conditioning), their concat-conditioned variants
``"sd15_inpaint"``, ``"sd21_inpaint"``, ``"sdxl_inpaint"`` (9-channel UNets),
``"sd2_depth"`` (5) and ``"sd15_ip2p"`` (8), the staged ones ``"sd15_lcm"``
(the guidance embedded: no CFG batch, ``_use_cfg``), ``"sdxl_refiner"``
(``refine``, after a base's ``generate(denoising_end=, output="latent")``)
and ``"sd_x4"`` (``upscale``), or a ``PipelineConfig``.

Weights: ``model_dir=None`` builds random demo weights from a fixed seed;
else ``model_dir`` is a directory or one file holding a checkpoint of the
configuration's family (SD1.x, SD2.x with its OpenCLIP tower, SDXL or its
refiner in the sgm naming), loaded by ``io.weights.load_pipeline_params`` (the native
``*.sdtpu.safetensors`` preferred, then LDM-named ``*.safetensors``), with
``model_dir/ctokenizer.txt`` as the tokenizer when present. On a mesh a
native file is the port's checkpoint (``io.checkpoint``): each rank loads
only its slices from it, unless ``quantize`` or ``fuse_qkv`` need whole
leaves. A missing or
empty ``model_dir`` fails as ``RUNTIME_ERROR`` "model load failed: ..." and
latches; an orbax directory, a ControlNet (an adapter:
``load_controlnet``), or a checkpoint of another family than the
configuration's, is ``INVALID_ARGUMENT``. ``embeddings={placeholder:
source}`` loads textual-inversion embeddings (``load_embedding``);
``clip_skip`` taps a single-tower configuration's text tower ``clip_skip -
1`` blocks early.

Serving: ``generate`` takes a prompt or a list of prompts and a
``negative_prompt``; ``generate_batch``/``generate_batch_async`` take
requests with a ``prompt`` and their own ``guidance``, ``seed`` and
``negative_prompt``, padded to a power of two. Prompts may carry the
attention syntax and run past the 77-token window (``sdtpu_torch.text``);
``generate`` also takes prompt scheduling (``[from:to:when]``, ``[a|b]``)
within one window, on a single-tower configuration as the reference does.
A concat-conditioned configuration does not serve ``generate``: its UNet
needs the extra planes.

Image-conditioned serving (``sdtpu/engine/context.py:1439-1852``):
``img2img``, ``inpaint`` (a standard UNet re-pins the kept region; a 9-ch
one takes the mask and the masked image as planes), ``depth2img``
(``sd2_depth``), ``instruct_pix2pix`` (``sd15_ip2p``, the dual CFG) and
``hires_fix`` (a second pass at ``scale`` x the latent grid), each on a
prompt or a list of prompts with a ``negative_prompt``; and
``img2img_batch``/``inpaint_batch`` (and their ``_async`` forms), requests
with their own image, mask, ``guidance``, ``seed`` and
``negative_prompt``, a strength shared by the batch, padded to a power of
two with one generator a request. Each call's generator makes its draws in
the order ``pipeline.draw_noise`` fixes.
``sampler`` is any name of ``samplers.SAMPLERS`` (``"dpm"`` by default).

Per-request adapters (``sdtpu/engine/context.py:544-609, 701-788``):
``load_controlnet(name, source)`` registers a ControlNet (a tree,
``"random"`` demo weights, an LDM ``control_model.*`` file or a native
flat-tree file) that ``generate(control_image=, control=,
control_scale=)`` runs, one or several at once; ``load_lora(name, path)``
registers a LoRA adapter (a native ``.npz`` or a kohya ``.safetensors``),
and ``lora=`` selects it on every entry point (the constructor's ``lora=``
loads one as the default, or a dict of them). An adapter's overlay of the
towers is built once and shares every base tensor.

Multi-card serving (``sdtpu/engine/context.py:101-107``): ``mesh=(data,
model)`` on every rank of a process group of data x model ranks the caller
started (``torchrun``, ``init_process_group``); with no group the world is
one rank and ``(1, 1)`` runs with no collective. The parameters are split
at load by the tensor-parallel plan (``parallel.sharding``; a ControlNet at
``load_controlnet``, a LoRA adapter's overlay at its first use), a call's
batch by the data axis: each rank runs its rows and every rank returns the
whole batch. A call whose batch the data axis does not divide is
``INVALID_ARGUMENT`` with the reference's text; the batched entry points
pad to a multiple of it. A mesh larger than the world is
``INVALID_ARGUMENT`` with ``make_mesh``'s text. On the card each rank takes
``cuda:{LOCAL_RANK % device_count()}`` unless ``device`` names one.

The constructor takes the reference's keywords with its names, defaults
and positional order (``sdtpu/engine/context.py:60-84``); ``device`` is
the port's own, keyword-only and last. The knobs
(``sdtpu/engine/context.py:108-245``), each off by default: ``size`` (the
image side, a multiple of 8 x the VAE's factor), ``freeu``, ``tome_ratio``
(``set_tome_ratio``), ``deepcache`` (``set_deepcache``),
``guidance_rescale``, ``cfg_interval`` and ``pag_layers`` (the sections a
request's ``pag_scale`` perturbs; ``set_pag_scale`` sets a default);
``fuse_qkv`` fuses the attention projections of an unquantized UNet. A bad
value is ``INVALID_ARGUMENT`` with the reference's text; knobs that do not
compose (``pipeline.check_knobs``) too. ``log_level`` and ``self.logger``
are the reference's (``engine.logging``); ``threads > 1`` loads the models
and the tokenizer on two worker threads, as ``_init_mt`` does. The
reference's ``compile_cache`` (its XLA executable cache) has no effect
here: the kernels build into ``sdtpu_torch/_build/``.

The device is the card unless the caller asks for another:
``Context(...)`` runs on ``"cuda"`` and raises ``RUNTIME_ERROR`` where there
is no card (nothing falls back to the CPU); ``device="cpu"`` runs the plain
versions on the host. On a CUDA device ``kernels="auto"`` selects the
hand-written flash-attention kernel (``"cuda"``); elsewhere it selects the
plain PyTorch path (``"plain"``).
``"cuda_gn"`` adds the fused GroupNorm(+SiLU) kernel and ``"cuda_conv"``
the fused GN-prologue conv kernel, the counterparts of the reference's
``"pallas_gn"`` and ``"pallas_conv"``; both keep the flash kernel on.

``quantize`` selects the reference's serving modes, applied to the UNet after
the cast to the compute dtype: ``"int8"`` (W8A8 transformer matmuls,
``quant.ptq.quantize_unet``; dynamic per-row activation scales until the
caller runs ``ctx.params = quant.ptq.calibrate(ctx.params, ctx.cfg, prompts,
ctx.tokenizer)``), ``"int8w"`` (weight-only-int8 convs, which the fused conv
kernel reads under ``"cuda_conv"``) and ``"int8w_dense"`` (convs and matmuls,
the latter through the weight-only-int8 GEMM kernel); ``"none"`` is the
default.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sdtpu_torch import text as text_mod
from sdtpu_torch.config import CONFIGS, PipelineConfig
from sdtpu_torch.engine import logging as slog
from sdtpu_torch.engine import pipeline
from sdtpu_torch.engine.errors import ErrorCode, ErrorTable, SdtpuError
from sdtpu_torch.io import safetensors as st
from sdtpu_torch.io.checkpoint import load_checkpoint
from sdtpu_torch.io.kohya import load_lora_kohya
from sdtpu_torch.io.params import (cast_params, from_jax_tree,
                                   fuse_attention_projections, init_tree,
                                   param_count, tree_names)
from sdtpu_torch.io.weights import (UnsupportedCheckpoint, _unflatten_tree,
                                    load_controlnet_state_dict,
                                    load_pipeline_params, native_file)
from sdtpu_torch.models import controlnet
from sdtpu_torch.models.layers import disable_tf32
from sdtpu_torch.parallel import mesh as mesh_mod
from sdtpu_torch.parallel.sharding import (shard_adapter, shard_params,
                                           site_plan)
from sdtpu_torch.quant.ptq import (count_quantized, quantize_unet,
                                   quantize_weights_only)
from sdtpu_torch.samplers import SAMPLERS
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer
from sdtpu_torch.train.lora import apply_lora, load_lora_npz

KERNELS = ("cuda", "cuda_gn", "cuda_conv", "plain")
QUANTIZE = ("none", "int8", "int8w", "int8w_dense")


class Context:
    """Prompt -> uint8 image engine."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        steps: int = 20,
        sampler: str = "dpm",
        config: PipelineConfig | str = "sd15",
        log_level: slog.LogLevel = slog.LogLevel.ERROR,
        kernels: str = "auto",
        quantize: str = "none",
        threads: int = 3,
        seed: int = 0,
        size: Optional[int] = None,
        fuse_qkv: bool = False,
        mesh: Optional[tuple[int, int]] = None,
        compile_cache: Optional[str] = "~/.cache/sdtpu/xla",
        lora: Optional[str] = None,
        embeddings: Optional[dict] = None,
        cfg_interval: Optional[tuple] = None,
        clip_skip: int = 1,
        freeu: Optional[tuple] = None,
        guidance_rescale: float = 0.0,
        pag_layers: tuple = ("mid",),
        tome_ratio: float = 0.0,
        deepcache: Optional[int] = None,
        *,
        device="cuda",
    ) -> None:
        self.errors = ErrorTable()
        self._failed = False
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SdtpuError(
                ErrorCode.RUNTIME_ERROR,
                "no CUDA device (torch.cuda.is_available() is false); pass "
                "device='cpu' to run the plain versions on the host",
                self.errors)
        self.mesh = None
        #: the tensor-parallel plan of the tree (``sharding.site_plan``)
        self._plan: dict = {}
        if mesh is not None:
            self.mesh = self._make_mesh(mesh)
            if self.device == torch.device("cuda"):
                self.device = mesh_mod.rank_device()
        self.cfg = self._configure(config, size, clip_skip, freeu,
                                   tome_ratio, deepcache, guidance_rescale)
        self.logger = slog.Logger(log_level,
                                  name=f"sdtpu@{hex(id(self))[-4:]}")
        self.model_dir = Path(model_dir) if model_dir else None
        self.fuse_qkv = bool(fuse_qkv)
        self._embeddings: dict[str, int] = {}   # placeholder -> rows
        self.lora = lora
        self._adapters: dict = {}          # LoRA name -> adapter tree
        self._lora_params: dict = {}       # LoRA name -> overlaid tree
        self._lora_default: Optional[str] = None
        self._controlnets: dict = {}       # ControlNet name -> tree
        #: the default PAG strength of a generate call that passes none
        self._default_pag: Optional[float] = None
        if not isinstance(sampler, str) or sampler.lower() not in SAMPLERS:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"unknown sampler {sampler!r}; available: {sorted(SAMPLERS)}",
                self.errors)
        self.sampler = sampler
        self.cfg_interval = self._check_cfg_interval(cfg_interval)
        pag_layers = ((pag_layers,) if isinstance(pag_layers, str)
                      else tuple(pag_layers))
        if not set(pag_layers) <= {"down", "mid", "up"} or not pag_layers:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"pag_layers must be a non-empty subset of "
                f"('down', 'mid', 'up'), got {pag_layers!r}", self.errors)
        self.pag_layers = pag_layers
        if kernels == "auto":
            kernels = "cuda" if self.device.type == "cuda" else "plain"
        if kernels not in KERNELS:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"kernels must be auto|{'|'.join(KERNELS)}, got "
                f"{kernels!r} (quantization is the separate quantize= "
                f"option: {'|'.join(QUANTIZE)})",
                self.errors)
        self.kernels = kernels
        if quantize not in QUANTIZE:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"quantize must be none|int8|int8w|int8w_dense, got "
                f"{quantize!r}", self.errors)
        self.quantize = quantize
        self.seed = int(seed)
        self.steps = int(steps)
        self.params = None
        self.tokenizer: Optional[Tokenizer] = None
        self._uncond = None
        disable_tf32()
        with slog.logger_scope(self.logger):
            t0 = time.perf_counter()
            if self.steps < 1:
                self._fail(ErrorCode.INVALID_ARGUMENT,
                           f"steps must be >= 1, got {steps}")
            self._init_mt(threads, embeddings or {})
            self.init_seconds = time.perf_counter() - t0
            n = param_count(self.params or {})
            self.logger.info(
                f"initialized in {self.init_seconds:.2f}s "
                f"({n / 1e6:.1f}M params, device={self.device.type})")

    def _configure(self, config, size, clip_skip, freeu, tome_ratio,
                   deepcache, guidance_rescale) -> PipelineConfig:
        """The configuration by name (or as given) with the init-time knobs
        applied, each checked with the reference's text
        (``sdtpu/engine/context.py:108-193``)."""
        if isinstance(config, str):
            if config.lower() not in CONFIGS:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"unknown config {config!r}; available: "
                    f"{sorted(CONFIGS)}", self.errors)
            config = CONFIGS[config.lower()]
        replace = dataclasses.replace
        if size is not None:
            # the UNet and the VAE are convolutional: only the latent grid
            # changes
            if (isinstance(size, bool) or not isinstance(size, int)
                    or size % (8 * config.upscale)
                    or size < config.upscale * 8):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"size must be a positive multiple of "
                    f"{8 * config.upscale}, got {size}", self.errors)
            config = replace(config, latent_size=size // config.upscale)
        if clip_skip != 1:
            # A1111 "CLIP skip": tap the text tower clip_skip - 1 blocks
            # early, then the final LN (sdtpu/engine/context.py:123-139);
            # single-tower configurations only: XL's towers already tap
            # their penultimate hidden states
            if (not isinstance(clip_skip, int) or clip_skip < 1
                    or clip_skip > config.clip.layers
                    or config.clip2 is not None):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"clip_skip must be an int in [1, clip.layers] on a "
                    f"single-tower config, got {clip_skip!r}", self.errors)
            config = replace(config, clip=replace(
                config.clip, skip_last=clip_skip - 1))
        if freeu is not None:
            if not isinstance(freeu, (tuple, list)) or len(freeu) != 4:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"freeu must be (b1, b2, s1, s2), got {freeu!r}",
                    self.errors)
            config = replace(config, unet=replace(
                config.unet, freeu=tuple(float(v) for v in freeu)))
        if tome_ratio:
            config = replace(config, unet=replace(
                config.unet, tome_ratio=self._check_tome(
                    tome_ratio, "tome_ratio must be in (0, 0.75] (at most "
                    "the 3/4 of tokens outside the 2x2 merge targets), "
                    f"got {tome_ratio}")))
        if deepcache is not None:
            if (isinstance(deepcache, bool) or not isinstance(deepcache, int)
                    or deepcache < 2):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"deepcache must be an int interval >= 2 (full-eval "
                    f"cadence), got {deepcache!r}", self.errors)
            config = replace(config, deepcache_interval=deepcache)
        if guidance_rescale:
            if not 0.0 <= guidance_rescale <= 1.0:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"guidance_rescale must be in [0, 1], got "
                    f"{guidance_rescale}", self.errors)
            config = replace(config,
                             guidance_rescale=float(guidance_rescale))
        return config

    def _check_tome(self, ratio, why: str) -> float:
        if not 0.0 < ratio <= 0.75:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, why, self.errors)
        return float(ratio)

    def _check_cfg_interval(self, cfg_interval):
        """(lo, hi) floats with 0 <= lo < hi <= 1, or None."""
        if cfg_interval is None:
            return None
        why = (f"cfg_interval must be 0 <= lo < hi <= 1, got "
               f"{cfg_interval}")
        try:
            lo, hi = cfg_interval
            ok = 0.0 <= lo < hi <= 1.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, why, self.errors)
        return float(lo), float(hi)

    def _make_mesh(self, mesh):
        """``make_mesh(data=mesh[0], model=mesh[1])``; its ``ValueError`` (a
        mesh larger than the world) as ``INVALID_ARGUMENT`` with its text. A
        rank of the world outside the mesh has no rows to serve."""
        try:
            data, model = (int(v) for v in mesh)
            m = mesh_mod.make_mesh(data=data, model=model)
        except (TypeError, ValueError) as e:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, str(e),
                             self.errors) from e
        if not m.member:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"this rank is outside the {data}x{model} mesh", self.errors)
        return m

    def _check_batch(self, batch: int) -> None:
        """A call's batch must tile the mesh's data axis (the reference's
        text, ``sdtpu/engine/context.py:817-821``)."""
        if self.mesh is not None and batch % self.mesh.shape["data"]:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"batch {batch} not divisible by data axis "
                f"{self.mesh.shape['data']}", self.errors)

    @property
    def plan(self) -> dict:
        """The tensor-parallel plan the tree was split by
        (``sharding.site_plan``; empty off a mesh): with ``self.mesh``,
        what ``io.checkpoint.save_checkpoint`` takes to save
        ``self.params`` whole."""
        return self._plan

    def _shard(self, params):
        """``params`` (a tree of the pipeline's, keyed from its root) split
        for this rank by the tensor-parallel plan, the plan kept for the
        adapters (``sdtpu/engine/context.py:367-370``); as they are off a
        mesh."""
        if self.mesh is None:
            return params
        plan = site_plan(params, self.mesh.shape["model"], self.cfg)
        self._plan.update(plan)
        return shard_params(params, self.mesh, self.cfg, plan)

    # ------------------------------------------------------------------
    # phased init
    # ------------------------------------------------------------------

    def _fail(self, code: ErrorCode, reason: str):
        self._failed = True
        raise SdtpuError(code, reason, self.errors)

    def _init_mt(self, threads: int, embeddings: dict) -> None:
        """The phases (``sdtpu/engine/context.py:290-305``): with ``threads
        > 1`` the models and the tokenizer load on two worker threads, then
        the buffers; then the textual-inversion embeddings, which need the
        params (rows appended) and the tokenizer (placeholders
        registered)."""
        def phase(fn):
            def run():
                with torch.inference_mode(), slog.logger_scope(self.logger):
                    fn()
            return run

        if threads > 1:
            with _fut.ThreadPoolExecutor(max_workers=2) as ex:
                f_models = ex.submit(phase(self._load_models))
                f_tok = ex.submit(phase(self._load_tokenizer))
                f_models.result()
                f_tok.result()
        else:
            phase(self._load_models)()
            phase(self._load_tokenizer)()
        with torch.inference_mode(), mesh_mod.use(self.mesh):
            self._prepare_buffers()
            for word, src in embeddings.items():
                self.load_embedding(word, src)

    def _load_models(self) -> None:
        """The checkpoint under ``model_dir``, converted, cast to the
        compute dtype and moved one leaf at a time; or random demo weights
        from a fixed seed, cast one model at a time (the float32 copy of one
        model is freed before the next is built). Then quantized as
        ``quantize`` says: after the cast, and the UNet only
        (``sdtpu/engine/context.py:307-386``)."""
        t0 = time.perf_counter()
        try:
            dtype = self.cfg.compute_dtype
            sliced = self._sliced_file()
            if sliced is not None:
                # each rank reads and places only its slices of the file
                # (io.checkpoint): the quantizers and the fused projections
                # take whole leaves, and an LDM file's rules build whole
                # trees, so those keep the load-then-shard path
                params = load_checkpoint(sliced, self.cfg, dtype, self.mesh,
                                         self.device, plan=self._plan)
            elif self.model_dir is not None:
                params = load_pipeline_params(self.model_dir, self.cfg,
                                              dtype=dtype, device=self.device)
            else:
                self.logger.info("no model_dir: random-init demo weights")
                gen = torch.Generator(device=self.device).manual_seed(0)
                params = {name: cast_params(init_tree(name, self.cfg, gen,
                                                      self.device), dtype)
                          for name in tree_names(self.cfg)}
            if self.quantize == "int8":
                params = quantize_unet(params)
                self.logger.info(f"int8 PTQ: {count_quantized(params)} "
                                 f"matmul sites quantized")
            elif self.quantize.startswith("int8w"):
                dense_too = self.quantize == "int8w_dense"
                params["unet"] = quantize_weights_only(
                    params["unet"], include_dense=dense_too)
                self.logger.info(f"weight-only int8 ({self.quantize}): UNet "
                                 f"convs" + ("+matmuls" if dense_too else ""))
            elif self.fuse_qkv:
                # only an unquantized tree: the quantizers and the
                # checkpoint layout keep the unfused projections
                params = fuse_attention_projections(params)
            self.params = params if sliced is not None else self._shard(
                params)
            if self.lora is not None:
                # a string is the default adapter of every request that
                # selects none (``lora=""`` selects the base)
                spec = ({"default": self.lora} if isinstance(self.lora, str)
                        else dict(self.lora))
                if isinstance(self.lora, str):
                    self._lora_default = "default"
                for name, path in spec.items():
                    self.load_lora(name, path)
        except UnsupportedCheckpoint as e:
            self._fail(ErrorCode.INVALID_ARGUMENT, str(e))
        except Exception as e:  # noqa: BLE001 - init boundary, latched
            self._fail(ErrorCode.RUNTIME_ERROR, f"model load failed: {e}")
        self.logger.info(f"models loaded in {time.perf_counter() - t0:.2f}s")

    def _sliced_file(self):
        """The native file a rank of the mesh loads its slices from: on a
        mesh, with ``quantize="none"`` and unfused projections; else
        None."""
        if (self.mesh is None or self.model_dir is None
                or self.quantize != "none" or self.fuse_qkv):
            return None
        return native_file(self.model_dir)

    def _load_tokenizer(self) -> None:
        """``model_dir/ctokenizer.txt`` when there is one, else the demo
        tokenizer; its vocabulary must fit the model's."""
        try:
            flat = self.model_dir / "ctokenizer.txt" if self.model_dir else None
            if flat is not None and flat.exists():
                self.tokenizer = Tokenizer.from_flat_file(flat)
            else:
                self.tokenizer = Tokenizer.from_merges(DEMO_MERGES)
        except Exception as e:  # noqa: BLE001 - init boundary, latched
            self._fail(ErrorCode.RUNTIME_ERROR, f"tokenizer load failed: {e}")
        if self.tokenizer.vocab_size > self.cfg.clip.vocab_size:
            self._fail(
                ErrorCode.INVALID_ARGUMENT,
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {self.cfg.clip.vocab_size}")

    def _prepare_buffers(self) -> None:
        """Precompute the uncond ("") embedding."""
        self._uncond = self._embed_prompt("")

    def _tokens(self, text: str):
        ids = self.tokenizer.tokenize(text, self.cfg.clip.context_len)
        return torch.tensor([ids], dtype=torch.int64, device=self.device)

    def _embed_prompt(self, text: str):
        """One prompt's embedding [T, D]."""
        return pipeline.encode_text(self.params, self._tokens(text),
                                    self.cfg)[0]

    def _refuse_scheduling(self, texts) -> None:
        if any(text_mod.has_schedule(t or "", self.steps) for t in texts):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                "prompt scheduling ([from:to:when] / [a|b]) is supported "
                "on Context.generate only", self.errors)

    def _negative_embedding(self, negative: Optional[str]):
        """One window's uncond embedding: the cached ``""`` one, or the
        negative prompt's, its attention syntax stripped."""
        if not negative:
            return self._uncond
        return self._embed_prompt(text_mod.strip_syntax(negative)
                                  if text_mod.has_attention_syntax(negative)
                                  else negative)

    def _schedule_inputs(self, prompts: list[str]):
        """Prompt scheduling (``sdtpu/engine/context.py:839-941``): the
        prompts resolved at every step, deduplicated into V variants ->
        (tokens [V, B, 1, T], weights [V, B, 1, T], idx [steps]) on the
        host: the k = 1 chunked form carries each variant's weights. Each
        variant must fit one window."""
        L = self.cfg.clip.context_len
        variants, idx = text_mod.schedule_table(prompts, self.steps)
        tok_rows, w_rows = [], []
        for row in variants:
            per = [text_mod.chunked_tokens(self.tokenizer, p, L) for p in row]
            if any(t.shape[0] > 1 for t, _ in per):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"scheduled prompts must fit one {L}-token window "
                    f"(long-prompt chunking + scheduling is unsupported)",
                    self.errors)
            tok_rows.append(np.stack([t[0] for t, _ in per]))
            w_rows.append(np.stack([w[0] for _, w in per]))
        return (np.stack(tok_rows)[:, :, None], np.stack(w_rows)[:, :, None],
                idx)

    def _text_inputs(self, prompts: list[str], negatives: list):
        """-> (tokens, weights or None, one uncond embedding a negative),
        as ``sdtpu/engine/context.py:_build_text_inputs`` builds them.

        Everything fits one window and carries no weight: tokens [B, T]
        (attention syntax of unit weight stripped), weights None, the
        cached ``""`` embedding where a negative is empty. Else the long or
        weighted path: tokens and weights [B, k, T], every prompt and
        negative padded to the same chunk count k, and each uncond
        embedding [k*T, D] encoded with its weights."""
        L = self.cfg.clip.context_len
        negs = [n or "" for n in negatives]
        tok = self.tokenizer
        if not any(text_mod.needs_chunking(tok, t, L)
                   for t in prompts + [n for n in negs if n]):
            def plain(t):
                return (text_mod.strip_syntax(t)
                        if text_mod.has_attention_syntax(t) else t)

            tokens = torch.tensor([tok.tokenize(plain(p), L) for p in prompts],
                                  dtype=torch.int64, device=self.device)
            return tokens, None, [self._negative_embedding(n) for n in negs]
        k = max(text_mod.chunked_tokens(tok, t, L)[0].shape[0]
                for t in prompts + negs)

        def chunked(texts):
            per = [text_mod.chunked_tokens(tok, t, L, min_chunks=k)
                   for t in texts]
            return (torch.tensor(np.stack([t for t, _ in per]),
                                 dtype=torch.int64, device=self.device),
                    torch.tensor(np.stack([w for _, w in per]),
                                 device=self.device))

        tokens, weights = chunked(prompts)
        uncond = []
        for n in negs:
            nt, nw = chunked([n])
            uncond.append(pipeline.encode_text(self.params, nt, self.cfg,
                                               nw)[0])
        return tokens, weights, uncond

    # ------------------------------------------------------------------
    # knobs
    # ------------------------------------------------------------------

    def _use_cfg(self, guidance=None) -> bool:
        """Whether a call runs the CFG batch, the one rule every entry point
        takes (``sdtpu/engine/context.py:480-489``): never on a
        guidance-embedded (LCM) configuration, whose model takes the scale
        through its time MLP; else where ``guidance != 1``, and always for a
        batch (``guidance`` None: a request's 1.0 mixes its uncond half in
        with weight 0)."""
        if self.cfg.unet.time_cond_proj_dim:
            return False
        return guidance is None or guidance != 1.0

    def set_steps(self, steps: int) -> None:
        if steps < 1:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT, f"steps must be >= 1, got {steps}",
                self.errors)
        self.steps = int(steps)

    def set_seed(self, seed: int) -> None:
        self.seed = int(seed)

    def set_pag_scale(self, scale: float) -> None:
        """The PAG strength of a ``generate`` call that passes no
        ``pag_scale`` (and of ``hires_fix``'s first pass); 0 disables
        (``sdtpu/engine/context.py:502-506``)."""
        self._default_pag = float(scale) if scale else None

    def set_deepcache(self, interval: int) -> None:
        """DeepCache's full-eval cadence on a live context; 0 disables."""
        if interval and (isinstance(interval, bool)
                         or not isinstance(interval, int) or interval < 2):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"deepcache must be 0 (off) or an int >= 2, got {interval!r}",
                self.errors)
        self.cfg = dataclasses.replace(
            self.cfg, deepcache_interval=int(interval) if interval else None)

    def set_tome_ratio(self, ratio: float) -> None:
        """ToMe's merge ratio on a live context; 0 disables."""
        ratio = (self._check_tome(ratio, f"tome_ratio must be 0 (off) or in "
                                         f"(0, 0.75], got {ratio!r}")
                 if ratio else 0.0)
        self.cfg = dataclasses.replace(self.cfg, unet=dataclasses.replace(
            self.cfg.unet, tome_ratio=ratio))

    # ------------------------------------------------------------------
    # per-request adapters
    # ------------------------------------------------------------------

    def load_lora(self, name: str, path) -> None:
        """Register (or replace) the LoRA adapter ``name``: a kohya
        ``.safetensors`` file (UNet and text-tower sites, ``io.kohya``) or
        a native ``.npz`` (``train.lora``). The adapter tree is read once,
        onto the device in the compute dtype (the delta rounds its leaves
        to that dtype at every call, so a cast at load gives the same
        bytes); the overlay a request runs is built at its first use and
        shares every base tensor, so N adapters cost N adapter trees, not N
        models."""
        if str(path).endswith(".safetensors"):
            tree = load_lora_kohya(path, self.cfg)
        else:
            tree = load_lora_npz(path)
        self._adapters[name] = cast_params(_on(tree, self.device),
                                           self.cfg.compute_dtype)
        self._lora_params.pop(name, None)
        self.logger.info(f"LoRA adapter {name!r} loaded from {path}")

    def lora_names(self) -> list[str]:
        return sorted(self._adapters)

    def _params_for(self, lora: Optional[str]):
        """The tree a request runs (``sdtpu/engine/context.py:752-788``):
        ``None`` selects the context's default adapter, ``""`` the base;
        an adapter's overlay of the ``unet``, ``clip`` and ``clip2`` towers
        (a native adapter's of the UNet) is built once."""
        if lora is None:
            lora = self._lora_default
        if not lora:
            return self.params
        if lora not in self._adapters:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"unknown LoRA adapter {lora!r}; loaded: "
                f"{sorted(self._adapters)}", self.errors)
        p = self._lora_params.get(lora)
        if p is None:
            adapters = self._adapters[lora]
            if self.mesh is not None:
                adapters = shard_adapter(adapters, self.mesh, self._plan)
            p = dict(self.params)
            if isinstance(adapters, dict) and set(adapters) <= {
                    "unet", "clip", "clip2"}:
                for tower, overlay in adapters.items():
                    if overlay and tower in p:
                        p[tower] = apply_lora(p[tower], overlay)
            else:
                p["unet"] = apply_lora(p["unet"], adapters)
            self._lora_params[lora] = p
        return p

    def load_controlnet(self, name: str, source) -> None:
        """Register the ControlNet ``name`` (``sdtpu/engine/context.py:
        569-606``). ``source``: a tree of ``models.controlnet`` (the port's
        layout), ``"random"`` (demo weights, the zero convs drawn too, from
        a generator seeded with the count of loaded ControlNets plus one),
        or a ``.safetensors`` path: an LDM ``control_model.*`` checkpoint
        or a native flat tree (the JAX package's layout). Cast to the
        compute dtype on the device; neither quantized nor fused. A request
        selects it with ``generate(control=name, control_image=...)``."""
        dtype = self.cfg.compute_dtype
        if isinstance(source, dict):
            cn = _on(source, self.device)
        elif isinstance(source, str) and source == "random":
            gen = torch.Generator(device=self.device).manual_seed(
                len(self._controlnets) + 1)
            cn = controlnet.init(self.cfg.unet, gen, self.device,
                                 zero_init_outs=False)
        else:
            tensors = st.load_file(source)
            if any(k.startswith("control_model.") for k in tensors):
                cn = load_controlnet_state_dict(tensors, self.cfg, dtype=dtype,
                                                device=self.device)
            else:
                cn = from_jax_tree({"controlnet": _unflatten_tree(tensors)},
                                   self.cfg, dtype=dtype,
                                   device=self.device)["controlnet"]
        # split by the plan once at load: its transformer matmuls take the
        # Megatron pairs, its zero convs replicate (sdtpu/engine/context.py:
        # 598-604)
        self._controlnets[name] = self._shard(
            {"controlnet": cast_params(cn, dtype)})["controlnet"]
        self.logger.info(f"ControlNet {name!r} loaded")

    def controlnet_names(self) -> list[str]:
        return sorted(self._controlnets)

    def _resolve_control(self, control, control_image):
        """-> (a tuple of adapter trees, their hints float32 [N, B, H, W, C]
        on the host) or (None, None) (``sdtpu/engine/context.py:701-750``).
        Single values or parallel lists (multi-ControlNet); a uint8 image
        is scaled by 1/255; hints of batch 1 and B broadcast to B."""
        if control_image is None:
            if control:
                raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                                 "control= given without control_image",
                                 self.errors)
            return None, None
        imgs = (list(control_image) if isinstance(control_image,
                                                  (list, tuple))
                else [control_image])
        names = (list(control) if isinstance(control, (list, tuple))
                 else [control] * len(imgs))
        if len(names) != len(imgs):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"{len(names)} control names for {len(imgs)} control "
                f"images", self.errors)
        cns, hints = [], []
        for name, image in zip(names, imgs):
            if name is None:
                if len(self._controlnets) != 1:
                    raise SdtpuError(
                        ErrorCode.INVALID_ARGUMENT,
                        f"control adapter name required (loaded: "
                        f"{sorted(self._controlnets)})", self.errors)
                name = next(iter(self._controlnets))
            if name not in self._controlnets:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"unknown ControlNet {name!r}; loaded: "
                    f"{sorted(self._controlnets)}", self.errors)
            img = np.asarray(image)
            if img.ndim == 3:
                img = img[None]
            size = self.cfg.image_size
            if img.shape[1:3] != (size, size):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"control_image must be {size}x{size}, got "
                    f"{img.shape[1:3]}", self.errors)
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            cns.append(self._controlnets[name])
            hints.append(np.asarray(img, np.float32))
        b = max(h.shape[0] for h in hints)
        hints = [np.broadcast_to(h, (b,) + h.shape[1:]) for h in hints]
        return tuple(cns), torch.from_numpy(np.stack(hints))

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def _check_usable(self) -> None:
        if self._failed:
            raise SdtpuError(ErrorCode.INVALID_CONTEXT,
                             "context previously failed and gave up",
                             self.errors)

    def _check_output(self, output: str) -> None:
        if output not in ("image", "latent"):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"output must be image|latent, got {output!r}",
                             self.errors)

    def _run(self, what: str, fn):
        """``fn()`` under inference mode; any failure but an
        ``SdtpuError`` (a kernel wrapper's refusal, a failed build or
        launch, a torch error) comes out typed as ``RUNTIME_ERROR``,
        recorded, and the context stays usable."""
        try:
            with (torch.inference_mode(), slog.logger_scope(self.logger),
                  mesh_mod.use(self.mesh)):
                return fn()
        except SdtpuError:
            raise
        except Exception as e:  # noqa: BLE001 - call boundary, not latched
            raise SdtpuError(ErrorCode.RUNTIME_ERROR,
                             f"{what} failed: {type(e).__name__}: {e}",
                             self.errors) from e

    def _prompts(self, prompt) -> list:
        prompts = [prompt] if isinstance(prompt, str) else prompt
        if not isinstance(prompts, (list, tuple)) or not all(
                isinstance(p, str) for p in prompts):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             "prompt must be a string or a list of strings",
                             self.errors)
        if not prompts:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, "empty prompt list",
                             self.errors)
        return list(prompts)

    def _start_step(self, strength: float) -> int:
        """The first step a warm start runs: ``round(steps (1 -
        strength))``, within [0, steps - 1]."""
        start = int(round(self.steps * (1.0 - strength)))
        return min(max(start, 0), self.steps - 1)

    def _next_seed(self, seed: Optional[int]) -> int:
        if seed is None:
            seed = self.seed
            self.seed += 1
        return int(seed)

    def generate(self, prompt: str | list[str], guidance: float = 7.5,
                 seed: Optional[int] = None,
                 negative_prompt: Optional[str] = None,
                 out: Optional[np.ndarray] = None,
                 lora: Optional[str] = None, control_image=None,
                 control: Optional[str] = None, control_scale: float = 1.0,
                 denoising_end: Optional[float] = None,
                 output: str = "image",
                 pag_scale: Optional[float] = None) -> np.ndarray:
        """prompt -> uint8 RGB image [H, W, 3] (numpy, on the host), or
        [B, H, W, 3] for a list of prompts.

        ``negative_prompt`` replaces the ``""`` uncond embedding of the CFG
        mix for the whole call. ``seed`` overrides the context seed for
        this call; otherwise the context seed is used and incremented. One
        generator of that seed draws the latents of every prompt of a list
        (and then a ``NEEDS_NOISE`` sampler's step noise). ``out``: optional
        caller buffer to fill. ``output="latent"`` returns the float32
        scale-factored latents [h, w, 4] (or [B, ...]) instead of decoding.
        ``pag_scale``: perturbed-attention guidance's strength (Ahn et al.
        2024): one more UNet eval of the cond rows a step with the
        self-attention of the context's ``pag_layers`` replaced by the
        identity, and eps moved by ``pag_scale`` x (cond - perturbed); the
        context's default (``set_pag_scale``) when omitted. ``lora``: an
        adapter of ``load_lora``; ``""`` runs the base model, None the
        context's default adapter (the constructor's string ``lora=``).

        ControlNet: ``control_image`` ([H, W, C] or [B, H, W, C], uint8 or
        float in [0, 1], at the output size; a batch of one serves every
        prompt) conditions the call through the adapter ``control`` names
        (``load_controlnet``; optional where one is loaded), weighted by
        ``control_scale``. Lists of images and names (and of scales) run
        several ControlNets at once, their residuals summed.

        Two-stage calls (SDXL base and refiner): ``denoising_end`` in (0, 1]
        stops the loop after ``max(1, round(steps * denoising_end))`` steps;
        with ``output="latent"`` the noisy latents feed a refiner Context's
        ``refine(latents, prompt, denoising_start=...)`` on the same
        ``steps``.

        A prompt with scheduling (``[from:to:when]``, ``[a|b]``) conditions
        each step on its resolved text: the deduplicated variants encode
        into one table and each step gathers its own on the device. Each
        variant must fit one window; the negative prompt cannot be
        scheduled; the output is an image."""
        self._check_usable()
        self._check_in_channels("txt2img", "generate")
        prompts = self._prompts(prompt)
        self._check_batch(len(prompts))
        params = self._params_for(lora)
        cns, hint = self._resolve_control(control, control_image)
        if cns is not None:
            if hint.shape[1] not in (1, len(prompts)):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"control_image batch {hint.shape[1]} != prompt batch "
                    f"{len(prompts)}", self.errors)
            params = {**params, "controlnet": cns}
        self._check_output(output)
        if text_mod.has_schedule(negative_prompt or "", self.steps):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                "scheduling inside the negative prompt is not supported",
                self.errors)
        sched = None
        if any(text_mod.has_schedule(p, self.steps) for p in prompts):
            if (cns is not None or denoising_end is not None
                    or output != "image"):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    "prompt scheduling composes with plain txt2img only "
                    "(no ControlNet/two-stage/latent output yet)",
                    self.errors)
            if self.cfg.clip2 is not None:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    "prompt scheduling is single-tower only (XL pending)",
                    self.errors)
            sched = self._schedule_inputs(prompts)
        end_step = None
        if denoising_end is not None:
            if not 0.0 < denoising_end <= 1.0:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"denoising_end must be in (0, 1], got {denoising_end}",
                    self.errors)
            end_step = max(1, round(self.steps * denoising_end))
            if end_step == self.steps:
                end_step = None
        if pag_scale is None:
            pag_scale = self._default_pag
        # the scheduled program takes no PAG, as the reference's
        # (sdtpu/engine/context.py:839-941)
        pag = pag_scale is not None and sched is None
        self._check_knobs(pag=pag, scheduled=sched is not None,
                          control=cns is not None)
        seed = self._next_seed(seed)
        t0 = time.perf_counter()

        def call():
            idx = None
            h = None if hint is None else hint.to(self.device).expand(
                -1, len(prompts), -1, -1, -1)
            if sched is None:
                tokens, weights, (uncond,) = self._text_inputs(
                    prompts, [negative_prompt])
            else:
                tokens, weights, idx = (torch.from_numpy(a).to(self.device)
                                        for a in sched)
                tokens = tokens.long()
                uncond = self._negative_embedding(negative_prompt)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return pipeline.generate(
                params, tokens, uncond, gen, float(guidance),
                cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                use_cfg=self._use_cfg(guidance), kernels=self.kernels,
                output=output, token_weights=weights, sched_idx=idx,
                end_step=end_step, hint=h, control_scale=control_scale,
                **self._knob_kwargs(pag_scale if pag else None)
            ).cpu().numpy()

        res = self._run("generate", call)
        self.logger.info(
            f"image generation took {time.perf_counter() - t0:.3f}s "
            f"(steps={self.steps}, sampler={self.sampler}, seed={seed})")
        if isinstance(prompt, str):
            res = res[0]
        if output == "latent":
            return res
        if out is not None:
            if out.shape != res.shape or out.dtype != np.uint8:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"out buffer mismatch: {out.shape}/{out.dtype} vs "
                    f"{res.shape}/uint8", self.errors)
            np.copyto(out, res)
            return out
        return res

    def refine(self, latents, prompt: str | list[str], guidance: float = 7.5,
               seed: Optional[int] = None, denoising_start: float = 0.0,
               negative_prompt: Optional[str] = None,
               lora: Optional[str] = None) -> np.ndarray:
        """The second stage of a two-stage call (``sdtpu/engine/context.py:
        1108-1200``): go on denoising noisy latents, then decode.

            base = Context(config="sdxl")
            ref = Context(config="sdxl_refiner")
            lat = base.generate(p, denoising_end=0.8, output="latent")
            img = ref.refine(lat, p, denoising_start=0.8)

        ``latents``: the base's float32 ``output="latent"`` array ([h, w, C]
        or [B, h, w, C]), at the marginal of step ``round(steps *
        denoising_start)`` on this Context's ``steps`` (give both Contexts
        the same). ``denoising_start`` in [0, 1). The seed's generator draws
        as ``generate``'s does, so ``denoising_start=0`` from ``generate``'s
        own start latents gives ``generate``'s bytes. Any single-model
        configuration takes it too. ``lora`` as ``generate``'s."""
        self._check_usable()
        self._check_in_channels("txt2img", "refine")
        params = self._params_for(lora)
        if not 0.0 <= denoising_start < 1.0:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"denoising_start must be in [0, 1), got {denoising_start}",
                self.errors)
        start_step = round(self.steps * denoising_start)
        prompts = self._prompts(prompt)
        self._check_batch(len(prompts))
        lat = np.asarray(latents, np.float32)
        if lat.ndim == 3:
            lat = lat[None]
        want = (len(prompts), self.cfg.latent_size, self.cfg.latent_size,
                self.cfg.latent_channels)
        if lat.shape != want:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"latents shape {lat.shape} != {want}", self.errors)
        self._refuse_scheduling(prompts + [negative_prompt])
        self._check_knobs()
        seed = self._next_seed(seed)
        t0 = time.perf_counter()

        def call():
            tokens, weights, (uncond,) = self._text_inputs(
                prompts, [negative_prompt])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return pipeline.refine(
                params, tokens, uncond, gen, float(guidance),
                torch.from_numpy(lat).to(self.device), cfg=self.cfg,
                sampler=self.sampler, steps=self.steps,
                start_step=start_step, use_cfg=self._use_cfg(guidance),
                kernels=self.kernels, token_weights=weights,
                cfg_interval=self.cfg_interval).cpu().numpy()

        res = self._run("refine", call)
        self.logger.info(
            f"refine took {time.perf_counter() - t0:.3f}s "
            f"(steps={start_step}->{self.steps}, sampler={self.sampler})")
        return res[0] if isinstance(prompt, str) else res

    def generate_batch_async(self, requests: list[dict],
                             lora: Optional[str] = None,
                             output: str = "image"):
        """Enqueue one batched run of several independent requests and
        return ``finish()``, which copies the results to the host and
        returns one array per request, in order.

        Each request: ``prompt`` (str, required) and optional ``guidance``
        (7.5), ``seed`` (the context seed, incremented) and
        ``negative_prompt``, all a sample: a guidance vector, one
        generator a sample (the sample's latents, then its step noise), the
        uncond embeddings stacked. The batch is padded to the next power of
        two with copies of the first request; only the n real results come
        back. The CFG pair always runs (a guidance of 1.0 mixes in its
        uncond half with weight 0), except on a guidance-embedded (LCM)
        configuration: one UNet row a request, the guidances a [B]
        embedding (``_use_cfg``). A batch of one gives the bytes of
        ``generate``. A request's ``pag_scale``: where any request has one,
        the batch runs PAG's eval and the others take 0.0, an exact no-op
        (``sdtpu/engine/context.py:1342-1352``). ``lora`` selects one
        adapter for the whole batch; requests may carry one ``lora`` key
        instead, the same in each (``_batch_requests``). ``output="latent"``
        returns latents."""
        self._check_usable()
        self._check_in_channels("txt2img", "generate_batch")
        pad, seeds, guidance, params = self._batch_requests(
            requests, lora, output, pag_key=True)
        n = len(requests)
        pag_on = any("pag_scale" in r for r in requests)
        pscale = ([float(r.get("pag_scale", 0.0)) for r in pad] if pag_on
                  else None)
        t0 = time.perf_counter()

        def call():
            tokens, weights, uncond = self._text_inputs(
                [r["prompt"] for r in pad],
                [r.get("negative_prompt") for r in pad])
            gens = [torch.Generator(device=self.device).manual_seed(s)
                    for s in seeds]
            return pipeline.generate(
                params, tokens, torch.stack(uncond), gens, guidance,
                cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                use_cfg=self._use_cfg(), kernels=self.kernels, output=output,
                token_weights=weights, **self._knob_kwargs(pscale))

        res = self._run("generate_batch", call)
        self.logger.debug(f"batch of {n} (padded {len(pad)}) dispatched in "
                          f"{time.perf_counter() - t0:.3f}s")

        def finish() -> list[np.ndarray]:
            host = self._run("generate_batch", lambda: res[:n].cpu().numpy())
            self.logger.info(f"batch of {n} (padded {len(pad)}) took "
                             f"{time.perf_counter() - t0:.3f}s")
            return [host[i] for i in range(n)]

        return finish

    def generate_async(self, prompt: str | list[str], guidance: float = 7.5,
                       seed: Optional[int] = None,
                       negative_prompt: Optional[str] = None,
                       lora: Optional[str] = None):
        """Enqueue one generation and return ``finish()``, which copies the
        images to the host: uint8 [B, H, W, 3], a batch of one for a
        string (the reference returns the device array of that shape,
        ``sdtpu/engine/context.py:2043-2078``). The host may encode further
        prompts while the card runs. The context's ``cfg_interval`` and
        DeepCache apply; PAG does not, as in the reference. ``lora`` as
        ``generate``'s."""
        self._check_usable()
        self._check_in_channels("txt2img", "generate_async")
        prompts = self._prompts(prompt)
        self._check_batch(len(prompts))
        params = self._params_for(lora)
        self._refuse_scheduling(prompts + [negative_prompt])
        self._check_knobs()
        seed = self._next_seed(seed)

        def call():
            tokens, weights, (uncond,) = self._text_inputs(
                prompts, [negative_prompt])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return pipeline.generate(
                params, tokens, uncond, gen, float(guidance),
                cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                use_cfg=self._use_cfg(guidance), kernels=self.kernels,
                token_weights=weights, **self._knob_kwargs(None))

        res = self._run("generate_async", call)
        return lambda: self._run("generate_async", lambda: res.cpu().numpy())

    def _knob_kwargs(self, pag_scale):
        """``pipeline.generate``'s knob arguments: the context's
        ``cfg_interval``, and PAG where ``pag_scale`` (a float or one a
        sample) is given."""
        return dict(cfg_interval=self.cfg_interval, pag_scale=pag_scale,
                    pag_layers=None if pag_scale is None else self.pag_layers)

    def _check_knobs(self, pag=False, scheduled=False, ip2p=False,
                     control=False) -> None:
        """``pipeline.check_knobs`` before any work, its ``ValueError`` as
        ``INVALID_ARGUMENT`` with the reference's text."""
        try:
            pipeline.check_knobs(self.cfg, self.sampler.lower(), pag, ip2p,
                                 scheduled, control)
        except ValueError as e:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, str(e),
                             self.errors) from e

    def _batch_requests(self, requests, lora, output, check=None,
                        pag_key=False):
        """Validate a batch (``check(request)`` for a mode's own keys; with
        ``pag_key`` a request's ``pag_scale`` turns PAG on), pad it to the
        next power of two, and on a mesh on to a multiple of its data axis
        (``sdtpu/engine/context.py:1274-1277``), with copies of the first
        request -> (padded
        requests, one seed each, one guidance each, the parameters of the
        batch's adapter).

        One adapter serves a batch (``sdtpu/engine/context.py:1342-1352``):
        ``lora``, or the ``lora`` key the requests carry, which must be the
        same in each and agree with ``lora`` where both are given."""
        if not requests:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, "empty request list",
                             self.errors)
        for r in requests:
            if not isinstance(r, dict) or not isinstance(r.get("prompt"),
                                                         str):
                raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                                 "each request needs a string 'prompt'",
                                 self.errors)
            if check is not None:
                check(r)
        req_loras = {r.get("lora") for r in requests if "lora" in r}
        if len(req_loras) > 1 or (req_loras and lora is not None
                                  and lora not in req_loras):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"mixed LoRA adapters in one batch: "
                f"{sorted(map(str, req_loras))} — group requests by adapter",
                self.errors)
        if lora is None and req_loras:
            lora = next(iter(req_loras))
        params = self._params_for(lora)
        self._check_output(output)
        n = len(requests)
        p = 1 << (n - 1).bit_length()
        if self.mesh is not None:
            p = -(-p // self.mesh.shape["data"]) * self.mesh.shape["data"]
        pad = list(requests) + [requests[0]] * (p - n)
        self._refuse_scheduling([t for r in requests for t in (
            r["prompt"], r.get("negative_prompt"))])
        self._check_knobs(pag=pag_key and any("pag_scale" in r
                                              for r in requests))
        seeds = [self._next_seed(r.get("seed")) for r in pad]
        return (pad, seeds, [float(r.get("guidance", 7.5)) for r in pad],
                params)

    def generate_batch(self, requests: list[dict],
                       lora: Optional[str] = None,
                       output: str = "image") -> list[np.ndarray]:
        """``generate_batch_async``, finished."""
        return self.generate_batch_async(requests, lora, output)()

    # ------------------------------------------------------------------
    # image-conditioned serving
    # ------------------------------------------------------------------

    def img2img(self, prompt: str | list[str], image: np.ndarray,
                strength: float = 0.6, guidance: float = 7.5,
                seed: Optional[int] = None,
                negative_prompt: Optional[str] = None,
                lora: Optional[str] = None,
                output: str = "image") -> np.ndarray:
        """Image to image. ``image``: uint8 [H, W, 3] (or [B, H, W, 3] for
        a list of prompts) at the Context's resolution. ``strength`` in (0,
        1]: the share of the trajectory that runs; 1.0 ignores the image,
        small values stay close to it. The image's latents are a posterior
        sample of the seed's generator. ``output="latent"`` returns the
        float32 latents."""
        return self._image_conditioned(
            "img2img", prompt, image, None, strength, guidance, seed,
            negative_prompt, lora, output)

    def inpaint(self, prompt: str | list[str], image: np.ndarray,
                mask: np.ndarray, strength: float = 1.0,
                guidance: float = 7.5, seed: Optional[int] = None,
                negative_prompt: Optional[str] = None,
                lora: Optional[str] = None,
                output: str = "image") -> np.ndarray:
        """Inpainting. ``image``: uint8 [H, W, 3] (or [B, H, W, 3]);
        ``mask``: [H, W] (or [B, H, W]), uint8 (x / 255) or float in [0, 1]
        or bool: nonzero pixels are repainted from the prompt, zero pixels
        keep the image. A standard UNet re-pins the kept region every step;
        a dedicated 9-ch one (``sd15_inpaint``, ``sd21_inpaint``,
        ``sdxl_inpaint``) takes the mask and the masked image as planes."""
        return self._image_conditioned(
            "inpaint", prompt, image, mask, strength, guidance, seed,
            negative_prompt, lora, output)

    def depth2img(self, prompt: str | list[str], image: np.ndarray,
                  depth: np.ndarray, strength: float = 0.8,
                  guidance: float = 7.5, seed: Optional[int] = None,
                  negative_prompt: Optional[str] = None,
                  lora: Optional[str] = None,
                  output: str = "image") -> np.ndarray:
        """Depth-conditioned img2img (``sd2_depth``: a 5-ch UNet).
        ``depth``: [H, W] (or [B, H, W]) float, any monotone depth scale
        (the caller's estimator); it is normalized per sample to [-1, 1] at
        latent resolution."""
        return self._image_conditioned(
            "depth", prompt, image, None, strength, guidance, seed,
            negative_prompt, lora, output, depth=depth)

    def instruct_pix2pix(self, prompt: str | list[str], image: np.ndarray,
                         guidance: float = 7.5, image_guidance: float = 1.5,
                         seed: Optional[int] = None,
                         negative_prompt: Optional[str] = None,
                         lora: Optional[str] = None,
                         output: str = "image") -> np.ndarray:
        """Instruction-based editing (``sd15_ip2p``): ``prompt`` is the edit
        instruction, ``image`` the uint8 input. ``guidance`` steers toward
        the instruction, ``image_guidance`` toward the image; three UNet
        slots a step, from pure noise."""
        return self._image_conditioned(
            "ip2p", prompt, image, None, 1.0, guidance, seed,
            negative_prompt, lora, output, image_guidance=image_guidance)

    def upscale(self, prompt: str | list[str], image: np.ndarray,
                noise_level: int = 20, guidance: float = 9.0,
                seed: Optional[int] = None,
                negative_prompt: Optional[str] = None,
                lora: Optional[str] = None,
                output: str = "image") -> np.ndarray:
        """The x4 upscaler (``sd_x4``; ``sdtpu/engine/context.py:1825-1850``):
        text-guided 4x super-resolution. ``image``: the low-res uint8 [h, w,
        3] (or [B, h, w, 3]) on the latent grid (``cfg.latent_size``: 128^2
        -> 512^2). ``noise_level`` in [0, ``cfg.max_noise_level``): the
        noise augmentation of the low-res input, drawn from the seed's
        generator after the start latents and the step noise; higher frees
        the model from the input's artifacts. ``output="latent"`` returns
        the float32 latents."""
        if not 0 <= int(noise_level) < self.cfg.max_noise_level:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"noise_level must be in [0, {self.cfg.max_noise_level}), "
                f"got {noise_level}", self.errors)
        return self._image_conditioned(
            "upsc", prompt, image, None, 1.0, guidance, seed,
            negative_prompt, lora, output, noise_level=int(noise_level))

    def _image_conditioned(self, mode, prompt, image, mask, strength,
                           guidance, seed, negative_prompt, lora, output,
                           depth=None, image_guidance=None,
                           noise_level=None) -> np.ndarray:
        """The img2img, inpaint, depth2img, instruct-pix2pix and upscale
        path (``sdtpu/engine/context.py:1852-``): validate, encode the
        text, run the pipeline function on one generator of the seed."""
        self._check_usable()
        if not (0.0 < strength <= 1.0):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"strength must be in (0, 1], got {strength}",
                             self.errors)
        prompts = self._prompts(prompt)
        self._check_batch(len(prompts))
        params = self._params_for(lora)
        self._check_output(output)
        self._refuse_scheduling(prompts + [negative_prompt])
        # the x4 upscaler takes its low-res input on the latent grid
        size = (self.cfg.latent_size if mode == "upsc"
                else self.cfg.image_size)
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        want = (len(prompts), size, size, 3)
        if img.shape != want or img.dtype != np.uint8:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"image must be uint8 {want}, got {img.shape}/{img.dtype}",
                self.errors)
        self._check_in_channels(mode)
        plane = None
        if mode in ("inpaint", "depth"):
            name = "mask" if mode == "inpaint" else "depth"
            a = np.asarray(mask if mode == "inpaint" else depth)
            if a.ndim == 2:
                a = a[None]
            if a.shape != (len(prompts), size, size):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"{name} must be [B, {size}, {size}], got {a.shape}",
                    self.errors)
            plane = _plane(a, mode == "inpaint")
        self._check_knobs(ip2p=mode == "ip2p")
        start_step = self._start_step(strength)
        seed = self._next_seed(seed)

        def call():
            tokens, weights, (uncond,) = self._text_inputs(
                prompts, [negative_prompt])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            x = self._image_tensor(img)
            kw = dict(cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                      kernels=self.kernels, token_weights=weights,
                      output=output)
            if mode == "ip2p":
                return pipeline.instruct_pix2pix(
                    params, tokens, uncond, gen, float(guidance), x,
                    float(image_guidance), **kw)
            kw.update(use_cfg=self._use_cfg(guidance),
                      cfg_interval=self.cfg_interval)
            if mode == "upsc":
                return pipeline.upscale(
                    params, tokens, uncond, gen, float(guidance), x,
                    int(noise_level), **kw)
            kw["start_step"] = start_step
            if mode == "inpaint":
                return pipeline.inpaint(
                    params, tokens, uncond, gen, float(guidance), x,
                    self._plane_tensor(plane), **kw)
            if mode == "depth":
                kw["depth"] = self._plane_tensor(plane)
            return pipeline.img2img(params, tokens, uncond, gen,
                                    float(guidance), x, **kw)

        res = self._run(mode, lambda: call().cpu().numpy())
        return res[0] if isinstance(prompt, str) else res

    def _check_in_channels(self, mode: str, what: str = "") -> None:
        """The UNet input widths each mode takes, the one place they are
        written (``sdtpu/engine/context.py:943-953, 1888-1913``):
        "txt2img" (``what``: generate, generate_batch, hires_fix, refine)
        and "img2img" take plain latents, since a concat-conditioned conv_in
        needs its extra planes at every step; "inpaint" a standard or a
        dedicated 9-ch UNet; "depth" 5 channels; "ip2p" 8; "upsc" 7 and a
        class table. The batched paths check their mode here too."""
        lc = self.cfg.latent_channels
        ic = self.cfg.unet.in_channels
        rows = self.cfg.unet.num_class_embeds
        ok, why = {
            "txt2img": ((lc,), f"{what} needs a standard txt2img UNet; this "
                        f"config's takes {ic} input channels — use inpaint() "
                        f"(9-ch) or depth2img() (5-ch) instead"),
            "img2img": ((lc,), f"this config's UNet takes {ic} input "
                        f"channels (concat-conditioned checkpoint); use "
                        f"inpaint() or depth2img()"),
            "inpaint": ((lc, 2 * lc + 1), f"inpaint needs a standard "
                        f"({lc}-ch) or dedicated-inpaint ({2 * lc + 1}-ch) "
                        f"UNet, this config has {ic}"),
            "depth": ((lc + 1,), f"depth2img needs a depth-conditioned "
                      f"({lc + 1}-ch) UNet (config sd2_depth), this config "
                      f"has {ic}"),
            "ip2p": ((2 * lc,), f"instruct_pix2pix needs an {2 * lc}-ch UNet "
                     f"(config sd15_ip2p), this config has {ic}"),
            "upsc": ((lc + 3,) if rows else (), f"upscale needs a {lc + 3}-ch "
                     f"noise-level-conditioned UNet (config sd_x4), this "
                     f"config has {ic} channels/{rows} class rows"),
        }[mode]
        if ic not in ok:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, why, self.errors)

    def _image_tensor(self, img: np.ndarray):
        """uint8 [B, H, W, 3] -> float32 in [-1, 1] on the device."""
        return (torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
                .float() / 127.5 - 1.0)

    def _plane_tensor(self, plane: np.ndarray):
        return torch.from_numpy(plane).to(self.device)

    def hires_fix(self, prompt: str | list[str], scale: int = 2,
                  strength: float = 0.6, guidance: float = 7.5,
                  seed: Optional[int] = None,
                  negative_prompt: Optional[str] = None,
                  lora: Optional[str] = None,
                  output: str = "image") -> np.ndarray:
        """The two-pass "hires fix" (``sdtpu/engine/context.py:1691-1801``):
        txt2img at the Context's resolution, its clean latents
        nearest-upscaled by ``scale`` (an int >= 2), then the last
        ``round(steps * strength)`` steps (``strength`` in (0, 1)) at the
        larger grid, decoded: uint8 [H*scale, W*scale, 3] (batched for a
        list). Both passes draw from one generator of the seed, the second
        after the first (``pipeline.draw_noise``)."""
        self._check_usable()
        self._check_in_channels("txt2img", "hires_fix")
        if isinstance(scale, bool) or not isinstance(scale, int) or scale < 2:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"scale must be an int >= 2, got {scale!r}",
                             self.errors)
        if not (0.0 < strength < 1.0):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"strength must be in (0, 1), got {strength}",
                             self.errors)
        prompts = self._prompts(prompt)
        self._check_batch(len(prompts))
        params = self._params_for(lora)
        self._check_output(output)
        self._refuse_scheduling(prompts + [negative_prompt])
        # pass 1 is the reference's Context.generate: the context's PAG
        # default applies there (sdtpu/engine/context.py:1737-1739)
        self._check_knobs(pag=self._default_pag is not None)
        start_step = self._start_step(strength)
        seed = self._next_seed(seed)

        def call():
            tokens, weights, (uncond,) = self._text_inputs(
                prompts, [negative_prompt])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            kw = dict(cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                      use_cfg=self._use_cfg(guidance), kernels=self.kernels,
                      token_weights=weights)
            lat = pipeline.generate(params, tokens, uncond, gen,
                                    float(guidance), output="latent",
                                    **self._knob_kwargs(self._default_pag),
                                    **kw)
            return pipeline.hires_refine(
                params, tokens, uncond, gen, float(guidance), lat,
                scale=scale, start_step=start_step, output=output,
                cfg_interval=self.cfg_interval, **kw)

        res = self._run("hires_fix", lambda: call().cpu().numpy())
        return res[0] if isinstance(prompt, str) else res

    def img2img_batch_async(self, requests: list[dict],
                            strength: float = 0.6,
                            lora: Optional[str] = None,
                            output: str = "image"):
        """Enqueue one batched img2img run and return ``finish()``, which
        returns one array per request, in order
        (``sdtpu/engine/context.py:1439-1452``). Each request: ``prompt``
        and ``image`` (uint8 [H, W, 3]) required, and its own ``guidance``,
        ``seed`` and ``negative_prompt``; ``strength`` is shared by the
        batch. Padded to the next power of two with copies of the first
        request, one generator a request (its draws in
        ``pipeline.draw_noise``'s order): a batch of one gives the bytes of
        ``img2img``."""
        return self._image_batch_async("img2img", requests, strength, lora,
                                       output)

    def img2img_batch(self, requests: list[dict], strength: float = 0.6,
                      lora: Optional[str] = None,
                      output: str = "image") -> list[np.ndarray]:
        """``img2img_batch_async``, finished."""
        return self.img2img_batch_async(requests, strength, lora, output)()

    def inpaint_batch_async(self, requests: list[dict],
                            strength: float = 1.0,
                            lora: Optional[str] = None,
                            output: str = "image"):
        """Batched inpainting: ``img2img_batch_async`` with a ``mask``
        ([H, W], uint8 or float, nonzero = repaint) in each request; a
        standard or a 9-ch inpaint UNet."""
        return self._image_batch_async("inpaint", requests, strength, lora,
                                       output)

    def inpaint_batch(self, requests: list[dict], strength: float = 1.0,
                      lora: Optional[str] = None,
                      output: str = "image") -> list[np.ndarray]:
        """``inpaint_batch_async``, finished."""
        return self.inpaint_batch_async(requests, strength, lora, output)()

    def _image_batch_async(self, mode, requests, strength, lora, output):
        """``sdtpu/engine/context.py:1472-1626``: validate every request,
        pad, run the pipeline function once on the stacked inputs."""
        self._check_usable()
        if not (0.0 < strength <= 1.0):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"strength must be in (0, 1], got {strength}",
                             self.errors)
        self._check_in_channels(mode)
        size = self.cfg.image_size

        def check(r):
            im = np.asarray(r.get("image"))
            if im.shape != (size, size, 3) or im.dtype != np.uint8:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"each request needs a uint8 [{size},{size},3] 'image', "
                    f"got {im.shape}/{im.dtype}", self.errors)
            if mode == "inpaint" and np.asarray(r.get("mask")).shape != (
                    size, size):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"each request needs a [{size},{size}] 'mask', got "
                    f"{np.asarray(r.get('mask')).shape}", self.errors)

        pad, seeds, guidance, params = self._batch_requests(
            requests, lora, output, check)
        n = len(requests)
        start_step = self._start_step(strength)
        images = np.stack([np.asarray(r["image"]) for r in pad])
        masks = (np.stack([_plane(np.asarray(r["mask"]), True) for r in pad])
                 if mode == "inpaint" else None)

        def call():
            tokens, weights, uncond = self._text_inputs(
                [r["prompt"] for r in pad],
                [r.get("negative_prompt") for r in pad])
            gens = [torch.Generator(device=self.device).manual_seed(s)
                    for s in seeds]
            kw = dict(cfg=self.cfg, sampler=self.sampler, steps=self.steps,
                      start_step=start_step, use_cfg=self._use_cfg(),
                      kernels=self.kernels, token_weights=weights,
                      output=output, cfg_interval=self.cfg_interval)
            args = (params, tokens, torch.stack(uncond), gens, guidance,
                    self._image_tensor(images))
            if mode == "inpaint":
                return pipeline.inpaint(*args, self._plane_tensor(masks),
                                        **kw)
            return pipeline.img2img(*args, **kw)

        res = self._run(f"{mode}_batch", call)

        def finish() -> list[np.ndarray]:
            host = self._run(f"{mode}_batch",
                             lambda: res[:n].cpu().numpy())
            return [host[i] for i in range(n)]

        return finish

    def last_error(self, code: ErrorCode) -> Optional[str]:
        return self.errors.last(code)

    # ------------------------------------------------------------------
    # textual inversion
    # ------------------------------------------------------------------

    def load_embedding(self, placeholder: str, source) -> None:
        """Textual-inversion embedding (``sdtpu/engine/context.py:611-699``):
        the learned vector(s) append to each text tower's token-embedding
        table and the whitespace-free ``placeholder`` (e.g.
        ``"<my-style>"``) becomes a word of the prompt vocabulary that
        encodes to those rows.

        ``source``: a [k, D] (or [D]) array or tensor, a dict of them, or a
        path to an ``.npz``, an A1111 ``.pt`` (``string_to_param["*"]``,
        read with ``torch.load(weights_only=True)``) or a ``.safetensors``
        file of such a dict. A dual-tower configuration (SDXL) takes the
        keys ``"clip_l"`` and ``"clip_g"``, one [k, D] per tower; a single
        tower (the refiner's is bigG, ``"clip_g"``) takes its key, a single
        entry, or A1111's
        ``"emb_params"``. A multi-vector embedding (k > 1) takes k tokens
        of the window. A bad shape, key set or placeholder is
        ``INVALID_ARGUMENT``."""
        self._check_usable()
        # the refiner's one tower is clip2
        towers = tuple(t for t in ("clip", "clip2") if t in self.params)
        vecs = self._read_embedding_arrays(source, towers)
        k = int(vecs[0].shape[0]) if vecs[0].dim() == 2 else 0
        start = int(self.params[towers[0]]["token_embedding"].shape[0])
        new = {}
        for tower, vec in zip(towers, vecs):
            tp = dict(self.params[tower])
            table = tp["token_embedding"]
            if (vec.dim() != 2 or vec.shape[0] != k
                    or vec.shape[1] != table.shape[1]):
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"{tower} embedding must be [k, {table.shape[1]}], got "
                    f"{list(vec.shape)}", self.errors)
            tp["token_embedding"] = torch.cat(
                [table, vec.to(device=table.device, dtype=table.dtype)],
                dim=0)
            new[tower] = tp
        try:
            self.tokenizer.add_placeholder(placeholder,
                                           list(range(start, start + k)))
        except ValueError as e:
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT, str(e),
                             self.errors) from e
        self.params = {**self.params, **new}
        # the overlays hold the old tables
        self._lora_params.clear()
        self._embeddings[placeholder] = k

    def _read_embedding_arrays(self, source, towers):
        """-> one [k, D] float32 tensor of ``source`` a tower of ``towers``
        (see ``load_embedding``), on the host."""
        data = source
        if isinstance(source, (str, Path)):
            path = str(source)
            try:
                if path.endswith(".npz"):
                    with np.load(path) as z:
                        data = {k: z[k] for k in z.files}
                elif path.endswith(".pt"):
                    obj = torch.load(path, map_location="cpu",
                                     weights_only=True)
                    data = {"emb": obj["string_to_param"]["*"]}
                else:
                    data = st.load_file(path)
            except (OSError, ValueError, KeyError, TypeError, RuntimeError,
                    pickle.UnpicklingError) as e:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"cannot read embedding {path}: {type(e).__name__}: "
                    f"{e}", self.errors) from e
        if not isinstance(data, dict):
            data = {"emb": data}
        data = {k: torch.atleast_2d(torch.as_tensor(v).detach().cpu()
                                    .float())
                for k, v in data.items()}
        key_of = {"clip": "clip_l", "clip2": "clip_g"}
        if all(key_of[t] in data for t in towers):
            return [data[key_of[t]] for t in towers]
        if len(towers) == 1:
            if len(data) == 1:
                return [next(iter(data.values()))]
            for key in ("emb_params", "emb"):  # A1111 / the JAX package's
                if key in data:
                    return [data[key]]
        raise SdtpuError(
            ErrorCode.INVALID_ARGUMENT,
            f"cannot pick {[key_of[t] for t in towers]} embedding arrays "
            f"from keys {sorted(data)}", self.errors)

    def embedding_names(self) -> list[str]:
        return sorted(self._embeddings)


def _plane(a: np.ndarray, is_mask: bool) -> np.ndarray:
    """[B, H, W] mask or depth -> float32 [B, H, W, 1]; a uint8 mask is
    scaled by 1/255 (``sdtpu/engine/context.py:1931-1933``)."""
    scale = 255.0 if is_mask and a.dtype == np.uint8 else 1.0
    return (np.asarray(a, np.float32) / scale)[..., None]


def _on(tree, device):
    """Every tensor of ``tree`` on ``device`` (a tensor already there is
    kept)."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on(v, device) for v in tree]
    return tree.to(device)
