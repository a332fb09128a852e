"""Post-training int8 quantization of the port, the counterpart of
``sdtpu/quant``."""

from sdtpu_torch.quant.ptq import (
    QUANT_PARENTS,
    calibrate,
    count_quantized,
    quantize_unet,
    quantize_weight,
    quantize_weights_only,
)
from sdtpu_torch.quant.validate import image_metrics, validate_quantized

__all__ = ["QUANT_PARENTS", "calibrate", "count_quantized", "image_metrics",
           "quantize_unet", "quantize_weight", "quantize_weights_only",
           "validate_quantized"]
