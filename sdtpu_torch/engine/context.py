"""Context: the pipeline orchestrator, the counterpart of
``sdtpu/engine/context.py`` for the txt2img path.

Lifecycle: load models -> load tokenizer -> prepare buffers (the cached
uncond ``""`` embedding) -> generate. A failed phase latches the context:
every later ``generate`` raises ``INVALID_CONTEXT``. A failure inside one
``generate`` (a kernel wrapper, its build or launch, torch) comes out as
``SdtpuError(RUNTIME_ERROR)`` and latches nothing.

The device is always explicit: ``Context(..., device="cuda")``. On a CUDA
device ``kernels="auto"`` selects the hand-written flash-attention kernel
(``"cuda"``); elsewhere it selects the plain PyTorch path (``"plain"``).
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

import time
from typing import Optional

import numpy as np
import torch

from sdtpu_torch.config import CONFIGS, PipelineConfig
from sdtpu_torch.engine import pipeline
from sdtpu_torch.engine.errors import ErrorCode, ErrorTable, SdtpuError
from sdtpu_torch.io.params import cast_params, init_pipeline_params
from sdtpu_torch.models.layers import disable_tf32
from sdtpu_torch.quant.ptq import quantize_unet, quantize_weights_only
from sdtpu_torch.tokenizer import DEMO_MERGES, Tokenizer

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
        kernels: str = "auto",
        seed: int = 0,
        quantize: str = "none",
        *,
        device,
    ) -> None:
        self.errors = ErrorTable()
        self._failed = False
        self.device = torch.device(device)
        if isinstance(config, str):
            if config.lower() not in CONFIGS:
                raise SdtpuError(
                    ErrorCode.INVALID_ARGUMENT,
                    f"unknown config {config!r}; available: "
                    f"{sorted(CONFIGS)}", self.errors)
            config = CONFIGS[config.lower()]
        self.cfg = config
        if model_dir is not None:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                "checkpoint loading is not ported yet (sdtpu.io.weights is "
                "later work of the port); model_dir=None runs random demo "
                "weights", self.errors)
        if sampler != "dpm":
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                f"unknown sampler {sampler!r}: the port runs 'dpm' "
                f"(DPM-Solver++ 2M); the other samplers are later work",
                self.errors)
        self.sampler = "dpm"
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
        if self.steps < 1:
            self._fail(ErrorCode.INVALID_ARGUMENT,
                       f"steps must be >= 1, got {steps}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._load_models()
            self._load_tokenizer()
            self._prepare_buffers()
        self.init_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # phased init
    # ------------------------------------------------------------------

    def _fail(self, code: ErrorCode, reason: str):
        self._failed = True
        raise SdtpuError(code, reason, self.errors)

    def _load_models(self) -> None:
        """Random demo weights from a fixed seed, cast to the compute dtype
        one model at a time (the float32 copy of one model is freed before
        the next is built), then quantized as ``quantize`` says: after the
        cast, and the UNet only (``sdtpu/engine/context.py:335-359``)."""
        try:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_pipeline_params(self.cfg, gen, self.device)
            params = {k: cast_params(v, self.cfg.compute_dtype)
                      for k, v in params.items()}
            if self.quantize == "int8":
                params = quantize_unet(params)
            elif self.quantize.startswith("int8w"):
                params["unet"] = quantize_weights_only(
                    params["unet"],
                    include_dense=self.quantize == "int8w_dense")
            self.params = params
        except Exception as e:  # noqa: BLE001 - init boundary, latched
            self._fail(ErrorCode.RUNTIME_ERROR, f"model load failed: {e}")

    def _load_tokenizer(self) -> None:
        try:
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
        self._uncond = self._embed_prompt("")[0]

    def _tokens(self, text: str):
        ids = self.tokenizer.tokenize(text, self.cfg.clip.context_len)
        return torch.tensor([ids], dtype=torch.int64, device=self.device)

    def _embed_prompt(self, text: str):
        return pipeline.encode_text(self.params, self._tokens(text), self.cfg)

    # ------------------------------------------------------------------
    # knobs
    # ------------------------------------------------------------------

    def set_steps(self, steps: int) -> None:
        if steps < 1:
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT, f"steps must be >= 1, got {steps}",
                self.errors)
        self.steps = int(steps)

    def set_seed(self, seed: int) -> None:
        self.seed = int(seed)

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def generate(self, prompt: str, guidance: float = 7.5,
                 seed: Optional[int] = None,
                 out: Optional[np.ndarray] = None,
                 output: str = "image") -> np.ndarray:
        """prompt -> uint8 RGB image [H, W, 3] (numpy, on the host).

        ``seed`` overrides the context seed for this call; otherwise the
        context seed is used and incremented. ``out``: optional caller
        buffer to fill. ``output="latent"`` returns the float32
        scale-factored latents [h, w, 4] instead of decoding."""
        if self._failed:
            raise SdtpuError(ErrorCode.INVALID_CONTEXT,
                             "context previously failed and gave up",
                             self.errors)
        if not isinstance(prompt, str):
            raise SdtpuError(
                ErrorCode.INVALID_ARGUMENT,
                "prompt must be one string (batched prompts are later work "
                "of the port)", self.errors)
        if output not in ("image", "latent"):
            raise SdtpuError(ErrorCode.INVALID_ARGUMENT,
                             f"output must be image|latent, got {output!r}",
                             self.errors)
        if seed is None:
            seed = self.seed
            self.seed += 1
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        try:
            with torch.inference_mode():
                res = pipeline.generate(
                    self.params, self._tokens(prompt), self._uncond, gen,
                    float(guidance), cfg=self.cfg, steps=self.steps,
                    use_cfg=guidance != 1.0, kernels=self.kernels,
                    output=output)
                res = res[0].cpu().numpy()
        except SdtpuError:
            raise
        except Exception as e:  # noqa: BLE001 - call boundary, not latched
            # a kernel wrapper's refusal, a failed build or launch, a torch
            # error: typed and recorded, and the context stays usable
            raise SdtpuError(ErrorCode.RUNTIME_ERROR,
                             f"generate failed: {type(e).__name__}: {e}",
                             self.errors) from e
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

    def last_error(self, code: ErrorCode) -> Optional[str]:
        return self.errors.last(code)
