"""sdtpu_torch: the PyTorch/CUDA port of sdtpu (Stable Diffusion txt2img and
image-conditioned serving).

The port mirrors the JAX package's module and function names, imports
``torch`` and numpy and never ``jax`` or ``sdtpu``. Its hand-written CUDA
kernels live in ``sdtpu_torch/csrc`` and are built with nvcc at first use.
"""

from sdtpu_torch.config import SD15, TINY, PipelineConfig
from sdtpu_torch.engine.context import Context
from sdtpu_torch.engine.errors import ErrorCode, SdtpuError

__all__ = ["Context", "ErrorCode", "PipelineConfig", "SD15", "SdtpuError",
           "TINY"]
